create or replace temp view csv as
select d1.d_date_sk cs_sold_date_sk,
       cord_order_time cs_sold_time_sk,
       d2.d_date_sk cs_ship_date_sk,
       bc.c_customer_sk cs_bill_customer_sk,
       bc.c_current_cdemo_sk cs_bill_cdemo_sk,
       bc.c_current_hdemo_sk cs_bill_hdemo_sk,
       bc.c_current_addr_sk cs_bill_addr_sk,
       sc.c_customer_sk cs_ship_customer_sk,
       sc.c_current_cdemo_sk cs_ship_cdemo_sk,
       sc.c_current_hdemo_sk cs_ship_hdemo_sk,
       sc.c_current_addr_sk cs_ship_addr_sk,
       cc_call_center_sk cs_call_center_sk,
       sm_ship_mode_sk cs_ship_mode_sk,
       w_warehouse_sk cs_warehouse_sk,
       i_item_sk cs_item_sk,
       p_promo_sk cs_promo_sk,
       cord_order_id cs_order_number,
       clin_quantity cs_quantity,
       i_wholesale_cost cs_wholesale_cost,
       i_current_price cs_list_price,
       clin_sales_price cs_sales_price,
       clin_coupon_amt cs_coupon_amt,
       clin_ship_cost cs_ship_cost
from s_catalog_order
     join date_dim d1 on cast(cord_order_date as date) = d1.d_date
     join s_catalog_order_lineitem on cord_order_id = clin_order_id
     join date_dim d2 on cast(clin_ship_date as date) = d2.d_date
     join item on clin_item_id = i_item_id
     left join customer bc on cord_bill_customer_id = bc.c_customer_id
     left join customer sc on cord_ship_customer_id = sc.c_customer_id
     left join call_center on cord_call_center_id = cc_call_center_id
     left join ship_mode on cord_ship_mode_id = sm_ship_mode_id
     left join warehouse on clin_warehouse_id = w_warehouse_id
     left join promotion on clin_promotion_id = p_promo_id;

insert into catalog_sales
select cs_sold_date_sk, cs_sold_time_sk, cs_ship_date_sk,
       cs_bill_customer_sk, cs_bill_cdemo_sk, cs_bill_hdemo_sk,
       cs_bill_addr_sk, cs_ship_customer_sk, cs_ship_cdemo_sk,
       cs_ship_hdemo_sk, cs_ship_addr_sk, cs_call_center_sk,
       cast(null as integer) cs_catalog_page_sk, cs_ship_mode_sk,
       cs_warehouse_sk, cs_item_sk, cs_promo_sk, cs_order_number,
       cs_quantity, cs_wholesale_cost, cs_list_price, cs_sales_price,
       (cs_quantity * cs_list_price) - (cs_quantity * cs_sales_price)
           cs_ext_discount_amt,
       cs_quantity * cs_sales_price cs_ext_sales_price,
       cs_quantity * cs_wholesale_cost cs_ext_wholesale_cost,
       cs_quantity * cs_list_price cs_ext_list_price,
       cast(0.00 as decimal(7,2)) cs_ext_tax,
       cs_coupon_amt,
       cs_ship_cost cs_ext_ship_cost,
       (cs_quantity * cs_sales_price) - cs_coupon_amt cs_net_paid,
       (cs_quantity * cs_sales_price) - cs_coupon_amt cs_net_paid_inc_tax,
       ((cs_quantity * cs_sales_price) - cs_coupon_amt) + cs_ship_cost
           cs_net_paid_inc_ship,
       ((cs_quantity * cs_sales_price) - cs_coupon_amt) + cs_ship_cost
           cs_net_paid_inc_ship_tax,
       ((cs_quantity * cs_sales_price) - cs_coupon_amt)
           - (cs_quantity * cs_wholesale_cost) cs_net_profit
from csv;
