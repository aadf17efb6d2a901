create or replace temp view wrv as
select d_date_sk wr_returned_date_sk,
       t_time_sk wr_returned_time_sk,
       i_item_sk wr_item_sk,
       rc.c_customer_sk wr_refunded_customer_sk,
       rc.c_current_cdemo_sk wr_refunded_cdemo_sk,
       rc.c_current_hdemo_sk wr_refunded_hdemo_sk,
       rc.c_current_addr_sk wr_refunded_addr_sk,
       tc.c_customer_sk wr_returning_customer_sk,
       tc.c_current_cdemo_sk wr_returning_cdemo_sk,
       tc.c_current_hdemo_sk wr_returning_hdemo_sk,
       tc.c_current_addr_sk wr_returning_addr_sk,
       wp_web_page_sk wr_web_page_sk,
       r_reason_sk wr_reason_sk,
       wret_order_id wr_order_number,
       wret_return_qty wr_return_quantity,
       wret_return_amt wr_return_amt,
       wret_return_tax wr_return_tax,
       wret_return_amt + wret_return_tax wr_return_amt_inc_tax,
       wret_return_fee wr_fee,
       wret_return_ship_cost wr_return_ship_cost,
       wret_refunded_cash wr_refunded_cash,
       wret_reversed_charge wr_reversed_charge,
       wret_account_credit wr_account_credit,
       wret_return_fee + wret_return_ship_cost + wret_return_tax wr_net_loss
from s_web_returns
     join item on wret_item_id = i_item_id
     join date_dim on cast(wret_return_date as date) = d_date
     left join customer rc on wret_refund_customer_id = rc.c_customer_id
     left join customer tc on wret_return_customer_id = tc.c_customer_id
     left join web_page on wret_web_page_id = wp_web_page_id
     left join reason on wret_reason_id = r_reason_id
     left join time_dim on t_time = 43200;

insert into web_returns
select wr_returned_date_sk, wr_returned_time_sk, wr_item_sk,
       wr_refunded_customer_sk, wr_refunded_cdemo_sk, wr_refunded_hdemo_sk,
       wr_refunded_addr_sk, wr_returning_customer_sk, wr_returning_cdemo_sk,
       wr_returning_hdemo_sk, wr_returning_addr_sk, wr_web_page_sk,
       wr_reason_sk, wr_order_number, wr_return_quantity, wr_return_amt,
       wr_return_tax, wr_return_amt_inc_tax, wr_fee, wr_return_ship_cost,
       wr_refunded_cash, wr_reversed_charge, wr_account_credit, wr_net_loss
from wrv;
